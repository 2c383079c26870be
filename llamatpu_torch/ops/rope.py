"""Rotary position embeddings: table precompute (plain/Llama-3.1/YaRN scaling)
and application in both GGUF layouts (interleaved pairs (2i, 2i+1) and NeoX
half-split pairs (i, i + head_dim/2)).

The port's copy of the JAX package's `ops/rope.py`: the tables are the same
numpy float64 math cast to f32, so both packages hold identical tables; the
rotation runs in f32 and casts back to the input dtype. Plain torch (the JAX
package leaves RoPE to XLA too).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from llamatpu_torch.models.config import ModelConfig


def precompute_rope_tables(cfg: ModelConfig, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Returns (cos, sin) tables of shape [context_length, head_dim // 2]."""
    half = cfg.head_dim // 2
    i = np.arange(half, dtype=np.float64) * 2.0
    freqs = 1.0 / np.power(cfg.rope_theta, i / cfg.head_dim)
    mscale = 1.0

    if cfg.rope_scaling == "llama3":
        lo_wavelen = cfg.rope_original_context / cfg.rope_lo_freq_factor
        hi_wavelen = cfg.rope_original_context / cfg.rope_hi_freq_factor
        wavelen = 2.0 * math.pi / freqs
        smooth = (cfg.rope_original_context / wavelen - cfg.rope_lo_freq_factor) / (
            cfg.rope_hi_freq_factor - cfg.rope_lo_freq_factor
        )
        scaled = np.where(
            wavelen < hi_wavelen,
            freqs,
            np.where(
                wavelen > lo_wavelen,
                freqs / cfg.rope_scale_factor,
                (1.0 - smooth) * freqs / cfg.rope_scale_factor + smooth * freqs,
            ),
        )
        freqs = scaled
    elif cfg.rope_scaling == "yarn":
        freq_scale = 1.0 / cfg.rope_scale_factor

        def corr_dim(n_rot):
            return cfg.head_dim * math.log(cfg.rope_original_context / (n_rot * 2.0 * math.pi)) / (
                2.0 * math.log(cfg.rope_theta)
            )

        low = corr_dim(cfg.yarn_beta_fast)
        high = corr_dim(cfg.yarn_beta_slow)
        idx = np.arange(half, dtype=np.float64)
        ramp_y = (idx - low) / max(0.001, high - low)
        ramp = 1.0 - np.minimum(1.0, np.maximum(0.0, ramp_y))
        freqs = freq_scale * freqs * (1.0 - ramp) + freqs * ramp
        if cfg.yarn_log_multiplier > 0:
            mscale = 1.0 + 0.1 * cfg.yarn_log_multiplier * math.log(1.0 / freq_scale)

    pos = np.arange(cfg.context_length, dtype=np.float64)[:, None]
    angles = pos * freqs[None, :]
    return (np.cos(angles) * mscale).astype(dtype), (np.sin(angles) * mscale).astype(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               style: str) -> torch.Tensor:
    """Rotate q or k. x: [..., n_heads, head_dim]; cos/sin: [..., head_dim//2]
    broadcastable against x's leading dims (typically [B, T, 1, half])."""
    half = x.shape[-1] // 2
    if style == "neox":
        x0 = x[..., :half].float()
        x1 = x[..., half:].float()
        out = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    elif style == "interleaved":
        xr = x.reshape(*x.shape[:-1], half, 2).float()
        x0, x1 = xr[..., 0], xr[..., 1]
        out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                          dim=-1).reshape(x.shape)
    else:
        raise ValueError(f"rope style {style!r}")
    return out.to(x.dtype)
