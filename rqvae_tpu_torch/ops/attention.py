"""Masked scaled dot-product attention (counterpart of rqvae_tpu/ops/attention.py).

Dense path only: at the Amazon serving shape (81 encoder tokens, 32
beam-folded cross queries, <= 4 self keys) the JAX ``attend`` never reaches
a Pallas kernel either. Layout is (batch, seq, heads, head_dim) throughout.

``sdpa`` is written as the JAX one is, not with
``F.scaled_dot_product_attention``: scores in fp32 (q and k upcast, the
counterpart of ``preferred_element_type=float32``), fp32 softmax,
probabilities cast to ``v.dtype`` before the PV product, and fully masked
rows give zeros, not NaN.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def build_mask(q_len: int, k_len: int, *, causal: bool = False,
               k_mask: Optional[torch.Tensor] = None,
               device=None) -> Optional[torch.Tensor]:
    """(B or 1, 1, Nq, Nk) boolean attention mask; True = attend."""
    mask = None
    if causal:
        mask = torch.tril(torch.ones((q_len, k_len), dtype=torch.bool, device=device))[None, None]
    if k_mask is not None:
        km = k_mask[:, None, None, :]
        mask = km if mask is None else mask & km
    return mask


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, N, H, Dh) operands."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(dh))
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if mask is not None:
        probs = torch.where(torch.any(mask, dim=-1, keepdim=True), probs, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
           k_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Structured-mask attention entry point used by the transformer (the
    dense branch of the JAX ``attend``)."""
    mask = build_mask(q.shape[1], k.shape[1], causal=causal, k_mask=k_mask, device=q.device)
    return sdpa(q, k, v, mask)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, H*Dh) -> (B, N, H, Dh)."""
    b, n, d = x.shape
    return x.reshape(b, n, num_heads, d // num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, N, H, Dh) -> (B, N, H*Dh)."""
    b, n, h, dh = x.shape
    return x.reshape(b, n, h * dh)
