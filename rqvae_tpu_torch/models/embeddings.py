"""Semantic-ID and user-ID embedders (counterpart of rqvae_tpu/models/embeddings.py).

One sem-ID table with level-offset rows (``token_type * K + sem_id``); masked
or out-of-range ids hit a zeroed padding row. The table has
``K * D + 1`` rows rounded up to a multiple of 16, as in JAX, so JAX
parameters load unchanged. User ids use the hashing trick ``|id| % buckets``.
"""
from __future__ import annotations

from typing import Optional

import torch

from rqvae_tpu_torch.utils import initializers


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def sem_id_embedder_init(gen: torch.Generator, num_embeddings: int, sem_ids_dim: int,
                         embedding_dim: int, *, device="cpu") -> torch.Tensor:
    rows = _round_up(num_embeddings * sem_ids_dim + 1, 16)
    table = initializers.normal(gen, (rows, embedding_dim), device=device)
    table[num_embeddings * sem_ids_dim:] = 0.0
    return table


def sem_id_embed(table: torch.Tensor, sem_ids: torch.Tensor, token_type_ids: torch.Tensor,
                 num_embeddings: int, seq_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Level-offset lookup; invalid positions hit the (zeroed) last row."""
    padding_idx = table.shape[0] - 1
    idx = token_type_ids.long() * num_embeddings + sem_ids.long()
    if seq_mask is not None:
        idx = torch.where(seq_mask, idx, padding_idx)
    return table[idx.clamp(0, padding_idx)]


def user_id_embedder_init(gen: torch.Generator, num_buckets: int, embedding_dim: int, *,
                          device="cpu") -> torch.Tensor:
    return initializers.normal(gen, (num_buckets, embedding_dim), device=device)


def user_id_embed(table: torch.Tensor, user_ids: torch.Tensor) -> torch.Tensor:
    """Hashing trick: bucket = |id| mod num_buckets."""
    return table[torch.abs(user_ids.long()) % table.shape[0]]
