"""Inverted dropout drawn from an explicit ``torch.Generator`` (the port's
counterpart of the JAX package's ``_dropout`` helpers in
models/transformer.py and models/retrieval.py, and of the dropout inside
models/mlp.py).

The noise differs from ``jax.random`` for any seed: tests compare with the
JAX package at p = 0 and check the distribution of the mask here.
"""
from __future__ import annotations

from typing import Optional

import torch


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Zero each element with probability ``p`` and scale the kept ones by
    1 / (1 - p); identity when not training or p <= 0. ``generator`` lives on
    ``x``'s device."""
    if not training or p <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = torch.empty(x.shape, dtype=torch.bool, device=x.device).bernoulli_(
        1.0 - p, generator=generator)
    return torch.where(keep, x / (1.0 - p), 0.0)
