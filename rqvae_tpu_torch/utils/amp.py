"""Mixed precision (counterpart of rqvae_tpu/utils/amp.py).

The policy is the JAX package's, not ``torch.autocast``: master parameters
and AdamW state stay fp32; a training step calls
``cast_floating(params, torch.bfloat16)`` inside the differentiated loss
(``train/train_decoder.py``), so the forward and backward run in bf16 and
the gradients flow back through the cast onto the fp32 leaves. Serving runs
bf16 weights cast once. The fp32 islands stay where the JAX package keeps
them: RMSNorm statistics (models/normalize.py), attention scores and
softmax (ops/attention.py, ops/flash_attention.py and its kernels), and
logits before log_softmax (models/generation.py,
models/retrieval.cross_entropy_ignore). ``torch.autocast`` would cast at
other points (per op, by its own lists) and drift from the JAX reference.
"""
from __future__ import annotations

import torch

from rqvae_tpu_torch.utils.tree import tree_map


def cast_floating(tree, dtype: torch.dtype):
    """Cast every floating-point tensor leaf to ``dtype`` (ints/bools
    untouched); differentiable, and a no-op on leaves already in ``dtype``."""
    def cast(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return tree_map(cast, tree)
