"""Dataset registry (counterpart of rqvae_tpu/data/registry.py; the port
keeps its own copy): dataset names, their history lengths, and ``load``.

``load`` builds the SYNTHETIC item corpus (``data/synthetic.py``); its bundle
holds the items only. The other datasets' loaders and the user-sequence
datasets are not ported yet and raise.
"""
from __future__ import annotations

import enum
from typing import NamedTuple, Optional

from rqvae_tpu_torch.data.dataset import ItemDataset


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
    max_seq_len: int


def load(dataset: RecDataset | str, root: str, *, split: Optional[str] = None,
         need_seqs: bool = True, synthetic_kwargs: Optional[dict] = None) -> DataBundle:
    """The item corpus of ``dataset`` (SYNTHETIC only, items only)."""
    if isinstance(dataset, str):
        dataset = RecDataset[dataset]
    if dataset != RecDataset.SYNTHETIC:
        raise NotImplementedError(
            f"the {dataset.name} loader (artifacts under {root}) is not ported yet; "
            "only SYNTHETIC is"
        )
    if need_seqs:
        raise NotImplementedError("synthetic user sequences are not ported yet")
    from rqvae_tpu_torch.data.synthetic import synthetic_items

    kw = dict(synthetic_kwargs or {})
    items = synthetic_items(n_items=kw.pop("n_items", 1024),
                            feature_dim=kw.pop("feature_dim", 768), seed=kw.pop("seed", 0))
    return DataBundle(items, MAX_SEQ_LEN[dataset])
