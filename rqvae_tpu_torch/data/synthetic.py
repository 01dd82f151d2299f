"""Synthetic data (the port's own copy of rqvae_tpu/data/synthetic.py):
``synthetic_items``, unit-norm item embeddings with cluster structure, so
that an RQ-VAE can compress them, and ``synthetic_sequences``, user
histories that favour two clusters each, so that next-item prediction is
learnable. Both draw from a numpy seed in the JAX package's order: the same
seed gives the same arrays."""
from __future__ import annotations

import numpy as np

from rqvae_tpu_torch.data.dataset import ItemDataset, SeqDataset


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


def synthetic_sequences(
    n_items: int,
    n_users: int = 256,
    max_seq_len: int = 20,
    *,
    seed: int = 1,
    n_clusters: int = 16,
) -> tuple[SeqDataset, SeqDataset]:
    """(train, eval) user histories. Each user samples from 2 preferred
    clusters with occasional exploration; the future item follows the same
    preference. The eval split has max(8, n_users // 10) users."""
    rng = np.random.default_rng(seed)
    item_cluster = rng.integers(0, n_clusters, size=(n_items,))
    items_by_cluster = [np.where(item_cluster == c)[0] for c in range(n_clusters)]
    items_by_cluster = [c if len(c) else np.arange(n_items) for c in items_by_cluster]

    def sample_user():
        prefs = rng.choice(n_clusters, size=2, replace=False)
        length = int(rng.integers(4, max_seq_len + 1))
        seq = []
        for _ in range(length + 1):
            c = prefs[rng.integers(0, 2)] if rng.random() < 0.9 else rng.integers(0, n_clusters)
            pool = items_by_cluster[int(c)]
            seq.append(int(pool[rng.integers(0, len(pool))]))
        return seq

    def build(n, uid0):
        user_ids = np.arange(uid0, uid0 + n, dtype=np.int32)
        rows = np.full((n, max_seq_len), -1, np.int32)
        futs = np.zeros((n, 1), np.int32)
        for i in range(n):
            seq = sample_user()
            hist = seq[:-1][:max_seq_len]
            rows[i, : len(hist)] = hist
            futs[i, 0] = seq[-1]
        return SeqDataset(user_ids=user_ids, item_ids=rows, item_ids_fut=futs,
                          max_seq_len=max_seq_len)

    n_eval = max(8, n_users // 10)
    return build(n_users, 0), build(n_eval, n_users)
