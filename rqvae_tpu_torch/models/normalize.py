"""Normalization primitives (counterpart of rqvae_tpu/models/normalize.py)."""
from __future__ import annotations

import torch

from rqvae_tpu_torch.utils.device import resolve_device


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(p=2) semantics: x / max(||x||, eps)."""
    n = torch.linalg.vector_norm(x, ord=2, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 statistics. The normalized value is cast back to
    ``x.dtype`` BEFORE the weight multiply, as in JAX; the other order
    drifts in bf16."""
    xf = x.float()
    normed = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return normed.to(x.dtype) * weight


def rms_norm_init(dim: int, *, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.ones((dim,), dtype=dtype, device=resolve_device(device))
