"""Mixed precision (counterpart of rqvae_tpu/utils/amp.py).

Serving runs bf16 weights; the fp32 islands stay where the JAX package keeps
them: RMSNorm statistics (models/normalize.py), attention scores and softmax
(ops/attention.py), and logits before log_softmax (models/generation.py,
models/retrieval.cross_entropy_ignore).
"""
from __future__ import annotations

import torch

from rqvae_tpu_torch.utils.tree import tree_map


def cast_floating(tree, dtype: torch.dtype):
    """Cast every floating-point tensor leaf to ``dtype`` (ints/bools untouched)."""
    def cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return tree_map(cast, tree)
