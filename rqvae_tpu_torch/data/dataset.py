"""Array-backed item dataset (the port's own copy of the item half of
rqvae_tpu/data/dataset.py): numpy rows of item features plus train / eval
membership, and the explicit slice of features to the model's input width.
The sequence datasets and batchers come with the decoder's data pipeline.
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
