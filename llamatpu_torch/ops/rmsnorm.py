"""RMSNorm: out = weight * x / sqrt(mean(x^2) + eps), the eps added AFTER the
mean (llama.cpp convention), the reduction always in float32 whatever the
activation dtype, the result cast back to it. Plain torch: the JAX package
leaves the unfused norm to XLA; the decode path folds it into the K2/K3
kernels (ops/layer_fused.py)."""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalize the last axis. x: [..., D]; weight: [D] (broadcast)."""
    xf = x.float()
    ss = torch.mean(xf * xf, dim=-1, keepdim=True) + eps
    return (xf * torch.rsqrt(ss) * weight.float()).to(x.dtype)
