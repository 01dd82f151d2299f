"""Bias-free SiLU MLP (counterpart of rqvae_tpu/models/mlp.py), eval mode.

Params are a list of (in, out) weight matrices; compute dtype follows ``x``.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from rqvae_tpu_torch.models.normalize import l2norm
from rqvae_tpu_torch.utils import initializers


def init(gen: torch.Generator, input_dim: int, hidden_dims: Sequence[int],
         out_dim: int, *, device="cpu") -> List[torch.Tensor]:
    dims = [input_dim, *hidden_dims, out_dim]
    return [
        initializers.linear(gen, d_in, d_out, device=device)
        for d_in, d_out in zip(dims[:-1], dims[1:])
    ]


def apply(params: List[torch.Tensor], x: torch.Tensor, *,
          normalize: bool = False) -> torch.Tensor:
    """SiLU between layers, never after the last; optional final l2norm."""
    in_dim = params[0].shape[0]
    if x.shape[-1] != in_dim:
        raise ValueError(f"Invalid input dim: expected {in_dim}, found {x.shape[-1]}")
    n = len(params)
    for i, w in enumerate(params):
        x = x @ w.to(x.dtype)
        if i != n - 1:
            x = F.silu(x)
    if normalize:
        x = l2norm(x)
    return x
