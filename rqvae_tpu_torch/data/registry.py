"""Dataset names and their history lengths (counterpart of the enum and
table at the top of rqvae_tpu/data/registry.py; the port keeps its own
copy). The dataset loaders themselves are not ported yet."""
from __future__ import annotations

import enum


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
