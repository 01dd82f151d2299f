"""Batch schemas (counterpart of rqvae_tpu/data/schemas.py).

NamedTuples of tensors. ``ids``/``sem_ids`` use -1 as the padding sentinel;
masks are bool, True = valid position.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor

FUT_SUFFIX = "_fut"   # the target fields' suffix: ids_fut, sem_ids_fut, ...


class SeqBatch(NamedTuple):
    """A batch in raw item-ID space."""

    user_ids: Tensor      # (B,) int32
    ids: Tensor           # (B, N) int32, -1 padded
    ids_fut: Tensor       # (B, 1) int32 target item
    x: Tensor             # (B, N, D_in) or (B, D_in) item features
    x_fut: Tensor         # (B, 1, D_in) or placeholder
    seq_mask: Tensor      # (B, N) bool


class TokenizedSeqBatch(NamedTuple):
    """A batch in semantic-ID token space; sem_ids flattens each item's
    D-tuple into the sequence (length N*D)."""

    user_ids: Tensor                       # (B,) int32
    sem_ids: Tensor                        # (B, N*D) int32, -1 padded
    sem_ids_fut: Optional[Tensor]          # (B, D) int32 or None
    seq_mask: Tensor                       # (B, N*D) bool
    token_type_ids: Tensor                 # (B, N*D) int32 in [0, D)
    token_type_ids_fut: Optional[Tensor]   # (B, D) int32 or None
