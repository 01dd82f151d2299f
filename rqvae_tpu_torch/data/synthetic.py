"""Synthetic item corpus (the port's own copy of ``synthetic_items`` in
rqvae_tpu/data/synthetic.py): unit-norm item embeddings with cluster
structure, so that an RQ-VAE can compress them, drawn from a numpy seed; the
same seed gives the same items as the JAX package."""
from __future__ import annotations

import numpy as np

from rqvae_tpu_torch.data.dataset import ItemDataset


def synthetic_items(
    n_items: int = 512,
    feature_dim: int = 18,
    n_clusters: int = 16,
    *,
    seed: int = 0,
    eval_frac: float = 0.05,
) -> ItemDataset:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, feature_dim))
    assignment = rng.integers(0, n_clusters, size=(n_items,))
    x = centers[assignment] + 0.15 * rng.normal(size=(n_items, feature_dim))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    is_train = rng.random(n_items) > eval_frac
    return ItemDataset(x=x, is_train=is_train)
