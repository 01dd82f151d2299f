"""Inverted dropout drawn from an explicit ``torch.Generator`` (the port's
counterpart of the JAX package's ``_dropout`` helpers in
models/transformer.py and models/retrieval.py, and of the dropout inside
models/mlp.py).

The noise differs from ``jax.random`` for any seed: tests compare with the
JAX package at p = 0 and check the distribution of the mask here.

Under tensor parallelism every rank of a model group draws from a generator
seeded alike (by its data coordinate), so the masks of whole activations
agree across the group; a column-sharded activation (``sharded=True``: the
FFN's hidden slice) takes its slice of a mask drawn at full width. A
tensor-parallel run then draws the masks one process draws with that seed.
"""
from __future__ import annotations

from typing import Optional

import torch

from rqvae_tpu_torch.parallel import tensor as tp


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator], *, sharded: bool = False) -> torch.Tensor:
    """Zero each element with probability ``p`` and scale the kept ones by
    1 / (1 - p); identity when not training or p <= 0. ``generator`` lives on
    ``x``'s device. ``sharded``: ``x`` is this rank's slice of the last dim
    of a column-parallel activation, and takes its slice of the whole mask."""
    if not training or p <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    shape = (*x.shape[:-1], x.shape[-1] * tp.size()) if sharded else x.shape
    keep = torch.empty(shape, dtype=torch.bool, device=x.device).bernoulli_(
        1.0 - p, generator=generator)
    if sharded:
        keep = tp.own_slice(keep)
    return torch.where(keep, x / (1.0 - p), 0.0)
