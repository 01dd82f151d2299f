"""Array-backed datasets (the port's own copy of rqvae_tpu/data/dataset.py):
``ItemDataset``, numpy rows of item features plus train / eval membership,
the explicit slice of features to the model's input width,
``SeqDataset``, user histories in item-ID space with the reference's
train-time random crop (the flat and packed samplers' source),
``make_seq_batch`` (a sampled batch as a ``SeqBatch`` of numpy arrays, which
``to_device`` moves to tensors) and the npz loaders of the preprocessed
artifacts.

``SeqDataset.batch_at`` crops through the native C batcher
(``rqvae_tpu_torch/native``, the port's copy of JAX's ``batcher.c``) where
JAX's does, with the seed drawn from the caller's generator as JAX draws it,
so one generator state gives JAX's native crops. ``RQVAE_TPU_DISABLE_NATIVE=1``
takes the Python path, row by row (``_subsample_row``, equal to JAX's
Python path); a failed native build raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rqvae_tpu_torch import native
from rqvae_tpu_torch.data.schemas import SeqBatch
from rqvae_tpu_torch.utils import profiling


@dataclasses.dataclass
class ItemDataset:
    """Per-item rows: features + train/eval membership."""

    x: np.ndarray          # (n_items, feature_dim) float32
    is_train: np.ndarray   # (n_items,) bool

    def __len__(self) -> int:
        return self.x.shape[0]

    def filtered(self, split: str) -> np.ndarray:
        if split == "train":
            return self.x[self.is_train]
        if split == "eval":
            return self.x[~self.is_train]
        if split == "all":
            return self.x
        raise ValueError(f"unknown split: {split}")


def features_for_model(x: np.ndarray, input_dim: int) -> np.ndarray:
    """Slice item features to the model's input width: wider artifacts (e.g.
    768 text + 6 genre dims) are cut to ``input_dim``; narrower ones are an
    error rather than a shape mismatch downstream."""
    width = x.shape[-1]
    if width < input_dim:
        raise ValueError(
            f"item features are {width}-dim but the model expects "
            f"{input_dim}; regenerate the artifacts or lower vae_input_dim"
        )
    return x[..., :input_dim] if width > input_dim else x


@dataclasses.dataclass
class SeqDataset:
    """User histories in item-ID space: ``item_ids`` (n_users,
    max_stored_len) int32, -1 padded (for the train split the full
    history, so the random crop can pick any window); ``item_ids_fut``
    (n_users, 1) int32 targets; ``max_seq_len`` the model-facing length."""

    user_ids: np.ndarray       # (n_users,) int32
    item_ids: np.ndarray       # (n_users, max_stored_len) int32, -1 padded
    item_ids_fut: np.ndarray   # (n_users, 1) int32
    max_seq_len: int

    def __len__(self) -> int:
        return self.user_ids.shape[0]

    def _subsample_row(self, rng: np.random.Generator, row: np.ndarray,
                       fut: int) -> tuple[np.ndarray, int]:
        """The reference's random crop: append the future item, pick start
        in [0, len - 3], end in [start + 3, start + max_seq_len + 1]; the
        crop's last element becomes the target. Returns (ids padded to
        max_seq_len with -1, target)."""
        seq = row[row >= 0].tolist() + [int(fut)]
        start = rng.integers(0, max(0, len(seq) - 3) + 1)
        end = rng.integers(start + 3, start + self.max_seq_len + 2)
        sample = seq[start:end]
        ids = sample[:-1]
        ids = ids + [-1] * (self.max_seq_len - len(ids))
        return np.asarray(ids, np.int32), sample[-1]

    def sample_batch(self, rng: np.random.Generator, batch_size: int, *,
                     subsample: bool = False) -> dict:
        """``batch_size`` users drawn uniformly; random crops when
        ``subsample``."""
        with profiling.span("data.sample"):
            idx = rng.integers(0, len(self), size=(batch_size,))
            return self._batch_at(idx, rng if subsample else None)

    def batch_at(self, idx: np.ndarray, rng: Optional[np.random.Generator] = None) -> dict:
        """A fixed-shape batch of the rows ``idx``: ``user_ids`` (B,),
        ``ids`` (B, max_seq_len) and ``ids_fut`` (B, 1), int32. With ``rng``
        each row is a random crop (the native batcher's, or the Python
        path's under ``RQVAE_TPU_DISABLE_NATIVE=1``); without, the last
        max_seq_len items."""
        with profiling.span("data.sample"):
            return self._batch_at(idx, rng)

    def _batch_at(self, idx: np.ndarray, rng: Optional[np.random.Generator]) -> dict:
        user_ids = self.user_ids[idx]
        if rng is not None and native.enabled():
            ids, fut = native.subsample_batch(self.item_ids, self.item_ids_fut, np.asarray(idx),
                                              self.max_seq_len, int(rng.integers(0, 2**63 - 1)))
            return {"user_ids": user_ids.astype(np.int32).reshape(-1), "ids": ids,
                    "ids_fut": fut[:, None]}
        if rng is not None:
            rows, futs = [], []
            for i in idx:
                r, f = self._subsample_row(rng, self.item_ids[i], int(self.item_ids_fut[i, 0]))
                rows.append(r)
                futs.append(f)
            ids = np.stack(rows)
            ids_fut = np.asarray(futs, np.int32)[:, None]
        else:
            ids = self.item_ids[idx][:, -self.max_seq_len:]
            if ids.shape[1] < self.max_seq_len:   # pad narrower storage
                pad = np.full((ids.shape[0], self.max_seq_len - ids.shape[1]), -1, np.int32)
                ids = np.concatenate([ids, pad], axis=1)
            ids_fut = self.item_ids_fut[idx].astype(np.int32)
        return {"user_ids": user_ids.astype(np.int32).reshape(-1),
                "ids": ids.astype(np.int32),
                "ids_fut": ids_fut}


def make_seq_batch(batch: dict, item_x: np.ndarray, *, with_features: bool = True) -> SeqBatch:
    """A sampled batch (``SeqDataset.batch_at``) as a ``SeqBatch`` of numpy
    arrays: item features gathered on the host, -1 at pads.
    ``with_features=False`` carries (.., 1) zero placeholders instead: decoder
    training reads only the ids (its tokenization is a cached-id lookup)."""
    with profiling.span("data.batch"):
        return _make_seq_batch(batch, item_x, with_features)


def _make_seq_batch(batch: dict, item_x: np.ndarray, with_features: bool) -> SeqBatch:
    ids = batch["ids"]
    ids_fut = batch["ids_fut"]
    seq_mask = ids >= 0
    if profiling.enabled():
        profiling.count("data.item_slots", ids.size)
        profiling.count("data.valid_items", int(seq_mask.sum()))
    if with_features:
        x = item_x[np.maximum(ids, 0)]
        x = np.where(seq_mask[..., None], x, -1.0).astype(np.float32)
        x_fut = item_x[np.maximum(ids_fut, 0)]
        x_fut = np.where((ids_fut >= 0)[..., None], x_fut, -1.0).astype(np.float32)
    else:
        x = np.zeros(ids.shape + (1,), np.float32)
        x_fut = np.zeros(ids_fut.shape + (1,), np.float32)
    return SeqBatch(user_ids=batch["user_ids"], ids=ids, ids_fut=ids_fut, x=x, x_fut=x_fut,
                    seq_mask=seq_mask)


def to_device(batch, device):
    """A batch of numpy arrays (a ``SeqBatch`` or a packed batch) as the
    same NamedTuple of tensors on ``device``."""
    with profiling.span("data.to_device"):
        return type(batch)(*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in batch))


def load_item_dataset(path: str) -> ItemDataset:
    z = np.load(path, allow_pickle=False)
    return ItemDataset(x=z["x"].astype(np.float32), is_train=z["is_train"].astype(bool))


def load_seq_dataset(path: str, max_seq_len: int) -> SeqDataset:
    z = np.load(path, allow_pickle=False)
    return SeqDataset(
        user_ids=z["user_ids"].astype(np.int32),
        item_ids=z["item_ids"].astype(np.int32),
        item_ids_fut=z["item_ids_fut"].astype(np.int32),
        max_seq_len=max_seq_len,
    )
