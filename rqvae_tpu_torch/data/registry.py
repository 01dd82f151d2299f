"""Dataset registry (counterpart of rqvae_tpu/data/registry.py; the port
keeps its own copy): dataset names, their history lengths, and ``load``.

``load`` builds SYNTHETIC items and user sequences from a seed
(``data/synthetic.py``; the eval split doubles as the test split, as in
JAX). The other datasets read the preprocessed ``.npz`` artifacts under
``<root>/processed[_<split>]/`` (``items.npz``, ``seqs_{train,eval,test}.npz``)
and raise ``FileNotFoundError`` when they are missing: the raw-file
preprocessors ``rqvae_tpu_torch.data.amazon`` / ``movielens`` write them.
"""
from __future__ import annotations

import enum
import os
from typing import NamedTuple, Optional

from rqvae_tpu_torch.data.dataset import (
    ItemDataset,
    SeqDataset,
    load_item_dataset,
    load_seq_dataset,
)


class RecDataset(enum.Enum):
    AMAZON = 1
    ML_1M = 2
    ML_32M = 3
    SYNTHETIC = 4


MAX_SEQ_LEN = {
    RecDataset.AMAZON: 20,
    RecDataset.ML_1M: 200,
    RecDataset.ML_32M: 200,
    RecDataset.SYNTHETIC: 20,
}


class DataBundle(NamedTuple):
    items: ItemDataset
    train_seqs: Optional[SeqDataset]
    eval_seqs: Optional[SeqDataset]
    test_seqs: Optional[SeqDataset]
    max_seq_len: int


def _artifact_dir(root: str, split: Optional[str]) -> str:
    return os.path.join(root, f"processed_{split}" if split else "processed")


def load(dataset: RecDataset | str, root: str, *, split: Optional[str] = None,
         need_seqs: bool = True, synthetic_kwargs: Optional[dict] = None) -> DataBundle:
    """Items and (unless ``need_seqs`` is False) the train / eval / test
    user sequences of ``dataset``."""
    if isinstance(dataset, str):
        dataset = RecDataset[dataset]
    max_seq_len = MAX_SEQ_LEN[dataset]

    if dataset == RecDataset.SYNTHETIC:
        from rqvae_tpu_torch.data.synthetic import synthetic_items, synthetic_sequences

        kw = dict(synthetic_kwargs or {})
        n_items = kw.pop("n_items", 1024)
        seed = kw.pop("seed", 0)
        items = synthetic_items(n_items=n_items, feature_dim=kw.pop("feature_dim", 768), seed=seed)
        if not need_seqs:
            return DataBundle(items, None, None, None, max_seq_len)
        train_seqs, eval_seqs = synthetic_sequences(
            n_items, n_users=kw.pop("n_users", 2048), max_seq_len=max_seq_len, seed=seed + 1)
        return DataBundle(items, train_seqs, eval_seqs, eval_seqs, max_seq_len)

    d = _artifact_dir(root, split)
    items_path = os.path.join(d, "items.npz")
    if not os.path.exists(items_path):
        raise FileNotFoundError(
            f"Missing preprocessed artifacts at {d}. Run the offline "
            "preprocessing first: python -m rqvae_tpu_torch.data.amazon --root "
            f"{root} --split {split or 'beauty'}  (or python -m "
            f"rqvae_tpu_torch.data.movielens --root {root} --variant ml1m|ml32m)"
        )
    items = load_item_dataset(items_path)
    if not need_seqs:
        return DataBundle(items, None, None, None, max_seq_len)
    seqs = {}
    for sp in ("train", "eval", "test"):
        p = os.path.join(d, f"seqs_{sp}.npz")
        seqs[sp] = load_seq_dataset(p, max_seq_len) if os.path.exists(p) else None
    return DataBundle(items, seqs["train"], seqs["eval"], seqs["test"], max_seq_len)
