"""Semantic-ID and user-ID embedders (counterpart of rqvae_tpu/models/embeddings.py).

One sem-ID table with level-offset rows (``token_type * K + sem_id``); masked
or out-of-range ids hit a zeroed padding row. The table has
``K * D + 1`` rows rounded up to a multiple of 16, as in JAX, so JAX
parameters load unchanged. User ids use the hashing trick ``|id| % buckets``.

Under tensor parallelism (``parallel/tensor``) each rank of a model group
holds rows [j V / m, (j + 1) V / m) of the sem-ID table (JAX's
``P('model', None)``): the lookup is vocab-parallel, each rank's lookups
outside its rows zeroed, then one ``all_reduce`` over the group.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from rqvae_tpu_torch.parallel import tensor as tp
from rqvae_tpu_torch.utils import initializers
from rqvae_tpu_torch.utils.device import resolve_device


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def sem_id_embedder_init(gen: torch.Generator, num_embeddings: int, sem_ids_dim: int,
                         embedding_dim: int, *, device=None) -> torch.Tensor:
    device = resolve_device(device)
    rows = _round_up(num_embeddings * sem_ids_dim + 1, 16)
    table = initializers.normal(gen, (rows, embedding_dim), device=device)
    table[num_embeddings * sem_ids_dim:] = 0.0
    return table


def sem_id_padding_idx(num_embeddings: int, sem_ids_dim: int) -> int:
    """The first zeroed row of the sem-ID table: the padding row of the
    reference's ``padding_idx`` (any row from there on is zero)."""
    return num_embeddings * sem_ids_dim


def sem_id_embed(table: torch.Tensor, sem_ids: torch.Tensor, token_type_ids: torch.Tensor,
                 num_embeddings: int, seq_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Level-offset lookup; invalid positions hit the (zeroed) last row.

    ``F.embedding`` rather than ``table[idx]``: the same gather, but its CUDA
    backward sums duplicate rows in parallel, where advanced indexing's
    backward walks each row's duplicates serially (the padding row alone
    takes ~140k lookups in an ML-32M batch). The padding row still gets its
    gradient, as in JAX (no ``padding_idx``). ``table`` is the rank's rows
    under tensor parallelism (vocab-parallel: see the module docstring)."""
    m = tp.size()
    rows = table.shape[0]
    padding_idx = rows * m - 1
    idx = token_type_ids.long() * num_embeddings + sem_ids.long()
    if seq_mask is not None:
        idx = torch.where(seq_mask, idx, padding_idx)
    idx = idx.clamp(0, padding_idx)
    if m == 1:
        return F.embedding(idx, table)
    local = idx - tp.index() * rows
    own = (local >= 0) & (local < rows)
    emb = F.embedding(local.clamp(0, rows - 1), table)
    return tp.reduce_from_model(torch.where(own[..., None], emb, 0.0))


def user_id_embedder_init(gen: torch.Generator, num_buckets: int, embedding_dim: int, *,
                          device=None) -> torch.Tensor:
    return initializers.normal(gen, (num_buckets, embedding_dim), device=resolve_device(device))


def user_id_embed(table: torch.Tensor, user_ids: torch.Tensor) -> torch.Tensor:
    """Hashing trick: bucket = |id| mod num_buckets."""
    return F.embedding(torch.abs(user_ids.long()) % table.shape[0], table)
